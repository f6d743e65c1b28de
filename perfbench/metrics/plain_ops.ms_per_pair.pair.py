"""Device time per traced pair of every device operation outside the
matcher's kernels (``perfbench/kernels/stereo_kernels``): the plain
PyTorch ops (cost volume, normalisation, refinement, gates,
triangulation) and the copies."""


def read(run):
    names = run.kernel_names("stereo_kernels")
    rest = sum(b - a for n, a, b in run.device_ops
               if not any(k in n for k in names)) / 1e3
    return rest / len(run.requests) if run.requests and run.device_ops \
        else None
