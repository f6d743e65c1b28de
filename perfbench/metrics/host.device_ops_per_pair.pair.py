"""Device operations (kernels, copies, fills) per traced pair, from the
profiler: what the host launches for one pair."""


def read(run):
    return len(run.device_ops) / len(run.requests) \
        if run.requests and run.device_ops else None
