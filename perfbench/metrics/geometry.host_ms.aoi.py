"""Host ms per traced AOI request of pair selection and each pair's
rectification geometry (float64 on the host): the program's
``aoi.geometry`` span (program_span)."""

from perfbench import program_spans


def read(run):
    return program_spans.mean_per_request(run, "aoi.geometry", "host_ms")
