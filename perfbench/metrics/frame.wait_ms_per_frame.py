"""Host milliseconds a traced frame was blocked on the device: the total
of the port's `wait` spans, the `nonzero` compactions that read a count
back from the device."""


def read(run):
    t = run.get("trace")
    if run["kind"] != "frames" or t is None:
        return None
    from simd_raytracer_tpu_torch.utils import profiling
    record = getattr(profiling, "record", None)
    wait = None if record is None else record()["spans"].get("wait")
    return None if wait is None else 1e3 * wait["total_s"] / t["units"]
