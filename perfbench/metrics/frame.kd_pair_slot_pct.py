"""Share of the kd kernel's pair slots that ran a needed pair test in the
traced frames: 100 * the kernel's `kd.tests` counter over `kd.slots`
(the staged live triangles of each leaf round times the block's rays)."""


def read(run):
    if run["kind"] != "frames" or run.get("trace") is None:
        return None
    from simd_raytracer_tpu_torch.utils import profiling
    record = getattr(profiling, "record", None)
    counts = {} if record is None else record()["counts"]
    if not counts.get("kd.slots"):
        return None
    return 100.0 * counts.get("kd.tests", 0) / counts["kd.slots"]
