"""Device kernels a frame (copies and sets left out), from the trace."""


def read(run):
    t = run.get("trace")
    if run["kind"] != "frames" or t is None or t["launches"] == 0:
        return None
    return t["launches"] / t["units"]
