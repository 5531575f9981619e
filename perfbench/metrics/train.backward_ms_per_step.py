"""Device milliseconds an SGD step of the kernels launched by ops that
ran inside autograd's backward, as the profiler ties each kernel to the
op that launched it."""


def read(run):
    t = run.get("trace")
    if run["kind"] != "sgd_steps" or t is None or not t.get("backward_s"):
        return None
    return 1e3 * t["backward_s"] / t["units"]
