"""Time to one fused product of the AOI: the window's whole span over the
requests it completed."""


def read(run):
    return run.window_s / len(run.requests) if run.requests else None
