"""Device ms per traced AOI request of the DSM layer (the grid's extent,
each pair's ``dsm_update`` and ``dsm_finalize_multi``): the program's
``aoi.dsm`` span (program_span)."""

from perfbench import program_spans


def read(run):
    return program_spans.mean_per_request(run, "aoi.dsm")
