"""Set-up: process start to the first timed request (imports, CUDA start,
the kernel library's load or build, the scene, geometry and warm-up)."""


def read(run):
    return run.setup_s
