"""Device ms per traced pair of the blunder gates, band recovery,
triangulation and plane-relative heights: the program's ``pair.finalise``
span (program_span)."""

from perfbench import program_spans


def read(run):
    return program_spans.mean_per_request(run, "pair.finalise")
