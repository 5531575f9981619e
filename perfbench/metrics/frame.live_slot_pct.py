"""Share of the render loop's wavefront slots that held a live ray in the
traced frames: 100 * the port's `render.live` counter (rays entering a
bounce) over `render.slots` (the wavefront's width at that bounce)."""


def read(run):
    if run["kind"] != "frames" or run.get("trace") is None:
        return None
    from simd_raytracer_tpu_torch.utils import profiling
    record = getattr(profiling, "record", None)
    counts = {} if record is None else record()["counts"]
    if not counts.get("render.slots"):
        return None
    return 100.0 * counts.get("render.live", 0) / counts["render.slots"]
