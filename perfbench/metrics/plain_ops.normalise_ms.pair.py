"""Device ms per traced pair of normalisation (the matcher's inputs, their
masks and the SNR ratio): the program's ``pair.normalise`` span
(program_span)."""

from perfbench import program_spans


def read(run):
    return program_spans.mean_per_request(run, "pair.normalise")
