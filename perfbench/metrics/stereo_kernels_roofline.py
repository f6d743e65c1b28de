"""Share of the roofline reached by the matcher's kernels on the traced
pairs: the least time of each pair's aggregation, WTA and right-view work
(``perfbench.roofline.pair_least_seconds``, from its (planes, rows, cols)
and the stereo config the run sized, as the driver records it) over the
device time of the kernels named under ``perfbench/kernels/stereo_kernels``."""


def read(run):
    names = run.kernel_names("stereo_kernels")
    busy = sum(b - a for n, a, b in run.device_ops
               if any(k in n for k in names)) / 1e6
    if not run.requests or busy <= 0:
        return None
    return 100.0 * sum(r["least_s"] for r in run.requests) / busy
