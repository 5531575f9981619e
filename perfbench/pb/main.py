"""One run of one cell: set-up, the measured (or traced) window, the check
of the answers against the plain reference, and the result line.

    python3 perfbench/run.py --workload W --seed N --seconds S --trace 0|1

The last line of standard output is one JSON object (`correct`,
`attempted`, `failed`, `metrics`, `device`, with `--trace 1` also
`breakdown`, and last `checks`); the numbers compared for `correct` are
also the last lines of standard error.  Without a CUDA device, or with
fewer than the cell asks for, it exits 2 and prints no result.
"""

from __future__ import annotations

import argparse
import gc
import json
import statistics
import sys
import time

import torch

from . import check, host, program, spec, trace

FORBIDDEN = ("jax", "jaxlib", "flax", "simd_raytracer_tpu")


def forbidden_modules() -> list:
    """Loaded modules whose top-level name, compared whole, is JAX's or
    the JAX package's."""
    return sorted(m for m in sys.modules if m.split(".")[0] in FORBIDDEN)


def parse(argv):
    p = argparse.ArgumentParser(prog="perfbench/run.py")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def fail(msg: str) -> int:
    print(f"perfbench: {msg}", file=sys.stderr)
    return 2


def measure(work, seconds: float) -> dict:
    """Units back to back until one ends past `seconds`."""
    times = []
    t0 = time.perf_counter()
    while True:
        times.append(work.unit())
        if time.perf_counter() - t0 >= seconds:
            break
    return {"unit_s": times, "window_s": time.perf_counter() - t0}


def execute(config: dict, traffic: dict, limits: dict, metrics: list,
            seed: int, seconds: float, traced: bool, device,
            started: float) -> dict:
    """Set-up, window, check and metrics of one run on `device` -> the
    result's `correct`, `attempted`, `failed`, `metrics`, `checks`, the
    device's peak memory, and with `traced` the trace's reduction."""
    kind = spec.kind(traffic["kind"])
    work = program.make(config, traffic, seed, device)
    work.setup()
    # What set-up left behind is never collected again: the window's
    # collections walk only what the window makes.
    gc.collect()
    gc.freeze()
    run = {"kind": traffic["kind"], "setup_s": time.perf_counter() - started,
           "spans": dict(work.spans), "has_accel": work.has_accel,
           "rays_per_unit": work.rays_per_unit}
    with host.Watch() as watch:
        if traced:
            run["trace"] = trace.traced_window(
                work, int(traffic["trace_units"]), backward=kind.BACKWARD)
            attempted = run["trace"]["units"]
        else:
            run.update(measure(work, seconds))
            attempted = len(run["unit_s"])
    peak = (torch.cuda.max_memory_allocated(device)
            if torch.device(device).type == "cuda" else 0)

    window_end = time.perf_counter()
    got, doc = work.answers(), work.doc
    work.free()
    del work
    gc.unfreeze()
    gc.collect()
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()
    want = kind.reference(doc, config, traffic, seed, device, torch.float32,
                          got)
    correct, rows = check.verdict(kind.compare(got, want), limits)
    if not traced:
        units = run["unit_s"]
        q = (statistics.quantiles(units, n=4) if len(units) > 1
             else [units[0]] * 3)
        print(f"perfbench: {len(units)} units, seconds first {units[0]:.4f}"
              f" min {min(units):.4f} quartiles {q[0]:.4f} {q[1]:.4f} "
              f"{q[2]:.4f} max {max(units):.4f}", file=sys.stderr)
    print("perfbench: " + watch.report(), file=sys.stderr)
    print(f"perfbench: set-up {run['setup_s']:.3f} s (spans {run['spans']}),"
          f" window ends {window_end - started:.3f} s after the start, check"
          f" took {time.perf_counter() - window_end:.3f} s", file=sys.stderr)
    values = {}
    for m in metrics:
        value = spec.reader(m["name"])(run)
        if value is not None:
            values[m["name"]] = {"value": value, "unit": m["unit"]}
    return {"correct": correct, "attempted": attempted,
            "failed": 0 if correct else attempted, "metrics": values,
            "checks": rows, "memory_peak_bytes": peak,
            "trace": run.get("trace")}


def main(argv, started: float) -> int:
    args = parse(argv)
    bench = spec.Spec()
    cell = bench.workload(args.workload)
    if not torch.cuda.is_available():
        return fail("no CUDA device: the benchmark runs on the card only")
    if torch.cuda.device_count() < int(cell["chips"]):
        return fail(f"{args.workload} needs {cell['chips']} CUDA devices, "
                    f"{torch.cuda.device_count()} found")
    device = torch.device("cuda", 0)
    out = execute(bench.config(cell["config"]), spec.traffic(cell["traffic"]),
                  spec.limits(args.workload),
                  bench.metrics("per_layer" if args.trace else "end_to_end",
                                args.workload),
                  args.seed, args.seconds, bool(args.trace), device, started)
    loaded = forbidden_modules()
    if loaded:
        return fail("JAX or the JAX package was loaded: " + ", ".join(loaded))
    dev = {"platform": "gpu", "kind": torch.cuda.get_device_name(device),
           "count": int(cell["chips"]),
           "memory_peak_bytes": out["memory_peak_bytes"]}
    result = {k: out[k] for k in ("correct", "attempted", "failed",
                                  "metrics")}
    result["device"] = dev
    if args.trace:
        dev.update(busy_s=out["trace"]["busy_s"],
                   window_s=out["trace"]["window_s"])
        result["breakdown"] = trace.breakdown(out["trace"])
    result["checks"] = out["checks"]
    for name, row in out["checks"].items():
        print(f"check {name} = {row['value']!r} (limit {row['limit']!r})",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result))
    return 0
