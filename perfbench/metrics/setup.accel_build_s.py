"""Host seconds of the benchmark's span around the port's accelerator
build (`ops/render.py::build_accel` and its move to the card, ending in
a synchronize); nothing where the select needs no accelerator."""


def read(run):
    if not run.get("has_accel"):
        return None
    return run["spans"]["accel_build"]
