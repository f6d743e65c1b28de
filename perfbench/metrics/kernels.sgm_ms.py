"""Device ms per traced pair of the left view's SGM and WTA: the four K1
directions and K2, the program's ``stereo.sgm`` span (program_span)."""

from perfbench import program_spans


def read(run):
    return program_spans.mean_per_request(run, "stereo.sgm")
