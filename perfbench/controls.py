"""Readings that the limits of `perfbench/limits/` are set from, at a
cell's own size, on the card.

    python3 perfbench/controls.py --workload CELL --seeds 1,2,3 \
        [--sound-seeds 4,5,...] [--units N]

Each variant runs `--units` units from the start of the window, as a
run's window does (at least the steps a step cell compares).

For each seed of `--seeds` it prints, one JSON line each, the numbers
compared for `correct` for:

- "sound": the program as the cell runs it;
- "control": the plain reference computed in bfloat16, the precision
  below the configuration's float32, in the program's place;
- each fault of the cell's kind of work (`FAULTS` in
  `perfbench/kinds/<kind>.py`) planted in the program's timed path.

`--sound-seeds` reads the sound program alone.  The benchmark's own runs
never run this.  Without a CUDA device it exits 2.
"""

import argparse
import contextlib
import json
import os
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
sys.path[:0] = [HERE, ROOT]

import torch  # noqa: E402

from pb import program, spec  # noqa: E402


def readings(config, traffic, seed, device, units, variants):
    """{variant: numbers} for one seed; every variant renders the same
    frames (or steps) with the same uniforms, from the window's start."""
    kind = spec.kind(traffic["kind"])
    units = max(units, int(traffic["check"].get("steps", 1)))
    work = program.make(config, traffic, seed, device)
    work.setup()
    got = {}
    for name in variants:
        if name == "control":
            continue
        plant = kind.FAULTS.get(name)
        with plant() if plant else contextlib.nullcontext():
            work.begin()
            for _ in range(units):
                work.unit()
            got[name] = work.answers()
    doc = work.doc
    work.free()
    del work
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()
    first = next(iter(got.values()))
    want = kind.reference(doc, config, traffic, seed, device, torch.float32,
                          first)
    out = {name: kind.compare(g, want) for name, g in got.items()}
    if hasattr(kind, "detail"):
        for name, g in got.items():
            out[name]["leaves"] = kind.detail(g, want)
    if "control" in variants:
        low = kind.reference(doc, config, traffic, seed, device,
                             torch.bfloat16, first)
        out["control"] = kind.compare(kind.as_answers(first, low), want)
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="perfbench/controls.py")
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", default="")
    p.add_argument("--sound-seeds", default="")
    p.add_argument("--units", type=int, default=2)
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("controls: no CUDA device", file=sys.stderr)
        return 2
    bench = spec.Spec()
    cell = bench.workload(args.workload)
    config = bench.config(cell["config"])
    traffic = spec.traffic(cell["traffic"])
    device = torch.device("cuda", 0)
    every = ["sound", "control"] + list(spec.kind(traffic["kind"]).FAULTS)
    plan = [(int(s), every) for s in args.seeds.split(",") if s] + [
        (int(s), ["sound"]) for s in args.sound_seeds.split(",") if s]
    for seed, variants in plan:
        t0 = time.perf_counter()
        for name, numbers in readings(config, traffic, seed, device,
                                      args.units, variants).items():
            print(json.dumps({"workload": args.workload, "seed": seed,
                              "variant": name, **numbers}), flush=True)
        print(f"controls: seed {seed} took {time.perf_counter() - t0:.1f} s",
              file=sys.stderr, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
