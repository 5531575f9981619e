"""Primary rays a second: H*W*spp of every frame the window completed,
over the window's host seconds (each frame ends in a synchronize)."""


def read(run):
    if run["kind"] != "frames" or "unit_s" not in run:
        return None
    return run["rays_per_unit"] * len(run["unit_s"]) / run["window_s"]
