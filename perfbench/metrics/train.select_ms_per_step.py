"""Device milliseconds an SGD step of the port's select kernels, by name."""

SELECT_KERNELS = ("sweep_select_kernel", "kd_select_kernel",
                  "mt_select_kernel", "fast_select_kernel")


def read(run):
    t = run.get("trace")
    if run["kind"] != "sgd_steps" or t is None:
        return None
    s = sum(v for k, v in t["kernel_s"].items()
            if any(name in k for name in SELECT_KERNELS))
    return 1e3 * s / t["units"] if s > 0 else None
