"""Share of the (ray tile, slice) pairs of the traced SGD steps' sweep
selects that the reach test kept: 100 * the port's `sweep.reached`
counter over `sweep.tiles_x_slices`.  It shows how much the slices'
boxes cull as the vertices move."""


def read(run):
    if run["kind"] != "sgd_steps" or run.get("trace") is None:
        return None
    from simd_raytracer_tpu_torch.utils import profiling
    record = getattr(profiling, "record", None)
    counts = {} if record is None else record()["counts"]
    if not counts.get("sweep.tiles_x_slices"):
        return None
    return (100.0 * counts.get("sweep.reached", 0)
            / counts["sweep.tiles_x_slices"])
