"""Forward and backward rays a second: the ray ids of every SGD step the
window completed, over the window's host seconds."""


def read(run):
    if run["kind"] != "sgd_steps" or "unit_s" not in run:
        return None
    return run["rays_per_unit"] * len(run["unit_s"]) / run["window_s"]
