"""Host milliseconds a traced SGD step spent refitting the sweep's slices
to the step's vertices: the total of the port's `refit` span (one a
binding of the select, `ops/intersect_sweep.py::bind`) over the traced
steps."""


def read(run):
    t = run.get("trace")
    if run["kind"] != "sgd_steps" or t is None:
        return None
    from simd_raytracer_tpu_torch.utils import profiling
    record = getattr(profiling, "record", None)
    refit = None if record is None else record()["spans"].get("refit")
    return None if refit is None else 1e3 * refit["total_s"] / t["units"]
