"""Host milliseconds a traced frame spent in `ops/shade.py::shade`
itself: the self time of the port's `shade` span, its occlusion queries,
marches and waits on the device left out."""


def read(run):
    t = run.get("trace")
    if run["kind"] != "frames" or t is None:
        return None
    from simd_raytracer_tpu_torch.utils import profiling
    record = getattr(profiling, "record", None)
    shade = None if record is None else record()["spans"].get("shade")
    return None if shade is None else 1e3 * shade["self_s"] / t["units"]
