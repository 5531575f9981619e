"""Seconds from the process's start to the first timed unit: imports,
the scene, the accelerator, the kernel builds and the warm-up."""


def read(run):
    return run["setup_s"]
