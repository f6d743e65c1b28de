"""Device ms per traced pair of refinement (guided-filter fill and
photoconsistency): the program's ``pair.refine`` span (program_span)."""

from perfbench import program_spans


def read(run):
    return program_spans.mean_per_request(run, "pair.refine")
