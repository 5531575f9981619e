"""Share of the traced window in which no device operation ran:
100 * (1 - union of device intervals / window)."""


def read(run):
    t = run.get("trace")
    if run["kind"] != "frames" or t is None or t["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - t["busy_s"] / t["window_s"])
