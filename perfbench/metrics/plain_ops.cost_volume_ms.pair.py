"""Device ms per traced pair of the census+AD cost volumes, the main one
and the band-recovery checker's: the program's ``stereo.cost_volume``
spans (program_span)."""

from perfbench import program_spans


def read(run):
    return program_spans.mean_per_request(run, "stereo.cost_volume")
