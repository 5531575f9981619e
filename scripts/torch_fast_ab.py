#!/usr/bin/env python3
"""The port's fast select beside an earlier tree's, in one process on one
CUDA card, on the calls of chip_smoke.py's phase 18 (a 480x480 refexact
frame of the full scene: its middle primary chunk, the largest march
call, the largest solid shadow call, the largest glass probe).

    python3 scripts/torch_fast_ab.py EARLIER_ROOT

EARLIER_ROOT is an earlier tree of this repo (a `git archive` of an
earlier commit unpacked into a git-ignored directory).  Its own
`simd_raytracer_tpu_torch` package is imported beside this tree's, under
another name, and its select is called through its own wrapper
(`ops/intersect_fast.py::mt_select_fast`, reading one table that its own
`fast_table` builds), so the script states no kernel interface: the
earlier kernels build from the earlier `csrc/` into the earlier `_build/`.

On each call both selects are held exactly against this tree's plain
version, then timed in turns, earlier, current, current, earlier (CUDA
events around 10 calls after one warm call, the wrapper's host work
included), each timing with the median SM clock and power that
`nvidia-smi` sampled every 100 ms while it ran; each kernel's own device
time is read by torch.profiler (chip_smoke.kernel_ms), and K1 is timed
once on the same call.  Prints the card, one JSON line per call and a
summary line.  Needs a CUDA device.
"""

from __future__ import annotations

import datetime
import importlib
import importlib.util
import json
import os
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REPS = 10
KERNEL = "fast_select_kernel"


class Sampler:
    """nvidia-smi sampling the SM clock and power every 100 ms."""

    def __init__(self):
        self.proc = subprocess.Popen(
            ["nvidia-smi", "--query-gpu=timestamp,clocks.sm,power.draw",
             "--format=csv,noheader,nounits", "-lms", "100"],
            stdout=subprocess.PIPE, text=True)
        self.rows = []

    def stop(self):
        self.proc.terminate()
        out, _ = self.proc.communicate(timeout=30)
        for line in out.splitlines():
            try:
                ts, mhz, watts = (x.strip() for x in line.split(","))
                at = datetime.datetime.strptime(
                    ts, "%Y/%m/%d %H:%M:%S.%f").timestamp()
                self.rows.append((at, float(mhz), float(watts)))
            except ValueError:
                continue

    def during(self, t0, t1):
        """Median SM MHz and W sampled in [t0, t1] (None when none)."""
        inside = [r for r in self.rows if t0 <= r[0] <= t1]
        if not inside:
            return None
        return {"sm_mhz": statistics.median(r[1] for r in inside),
                "watts": statistics.median(r[2] for r in inside),
                "samples": len(inside)}


def load_earlier(root: str):
    """ops.intersect_fast of the package in the tree at `root`, imported
    as `earlier_srt` (its relative imports stay inside that tree)."""
    pkg = os.path.join(os.path.abspath(root), "simd_raytracer_tpu_torch")
    spec = importlib.util.spec_from_file_location(
        "earlier_srt", os.path.join(pkg, "__init__.py"),
        submodule_search_locations=[pkg])
    module = importlib.util.module_from_spec(spec)
    sys.modules[spec.name] = module
    spec.loader.exec_module(module)
    return importlib.import_module("earlier_srt.ops.intersect_fast")


def main() -> int:
    import torch
    if not torch.cuda.is_available() or len(sys.argv) != 2:
        print(__doc__, file=sys.stderr)
        return 1
    sys.path[:0] = [ROOT, os.path.join(ROOT, "tests")]
    import chip_smoke as C
    import simd_raytracer_tpu_torch as T
    from simd_raytracer_tpu_torch import kernels
    from simd_raytracer_tpu_torch.ops import intersect_fast as F
    from simd_raytracer_tpu_torch.ops.intersect_brute import mt_select_brute
    from torch_scenes import mixed_doc

    print(C.smi(), flush=True)
    earlier = load_earlier(sys.argv[1])
    full = T.parse_scene_dict(mixed_doc(960, 960)).to("cuda")
    geom, _, kept = C.fast_calls(full)
    earlier_table = earlier.fast_table(geom.v0, geom.e1, geom.e2,
                                       torch.float32)
    sampler = Sampler()
    time.sleep(0.5)
    spans, results = [], {}
    try:
        for kind, (name, _) in C.FAST_CALLS.items():
            args = C.fast_args(kept[kind], geom)
            plain = F.mt_select_fast_reference(**args)
            sides = {
                "earlier": lambda a={**args, "table": earlier_table}:
                    earlier.mt_select_fast(**a),
                "current": lambda a=args: F.mt_select_fast(**a)}
            for side, fn in sides.items():
                C.exact(C.FAST, f"{side} {name}", fn(), plain)
            r, t = int(args["o"].shape[0]), int(geom.v0.shape[0])
            row = {"call": name, "rays": r,
                   "live_triangles": int(args["tri_mask"].sum()),
                   "split": kernels.split(
                       -(-r // (F.FAST_THREADS * F.FAST_WIDTH)),
                       -(-t // F.FAST_TILE), kernels.sm_count(0)),
                   "earlier_ms": [], "ms": []}
            for side in ("earlier", "current", "current", "earlier"):
                t0 = time.time()
                ms = C.event_ms(sides[side], REPS)
                spans.append((row, "ms" if side == "current" else
                              "earlier_ms", ms, t0, time.time()))
            for side, key in (("earlier", "earlier_kernel"),
                              ("current", "kernel")):
                row[f"{key}_ms"], row[f"{key}_launches_profiled"] = (
                    C.kernel_ms(sides[side], KERNEL, REPS))
            k1 = {k: v for k, v in args.items() if k != "table"}
            row["k1_ms"] = C.event_ms(
                lambda: mt_select_brute(
                    **k1, tri_soa=C.bound_table("jnp", geom)), REPS)
            results[name] = row
    finally:
        time.sleep(0.3)
        sampler.stop()
    for row, which, ms, t0, t1 in spans:
        row[which].append({"ms": ms, **(sampler.during(t0, t1) or {})})
    summary = {}
    for name, row in results.items():
        print(json.dumps(row), flush=True)
        old = statistics.mean(x["ms"] for x in row["earlier_ms"])
        new = statistics.mean(x["ms"] for x in row["ms"])
        summary[name] = {
            "earlier_ms": old, "ms": new, "ratio": new / old,
            "earlier_kernel_ms": row["earlier_kernel_ms"],
            "kernel_ms": row["kernel_ms"],
            "kernel_ratio": row["kernel_ms"] / row["earlier_kernel_ms"],
            "k1_ms": row["k1_ms"]}
    print(json.dumps({"summary": summary, "exact": True}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
