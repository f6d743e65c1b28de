"""Device ms per traced pair of the right view: K3, its two K1 directions
and its K2 argmin, the program's ``stereo.right`` span (program_span)."""

from perfbench import program_spans


def read(run):
    return program_spans.mean_per_request(run, "stereo.right")
