"""Device idle ms per traced pair while the host was inside the program's
``pair`` span: the gaps between device operations whose middle, on the
host clock, falls inside the span (program_span with the device trace);
the rest of the idle time is the caller's, between pairs."""

from perfbench import program_spans


def read(run):
    return program_spans.idle_in_spans_ms(run, "pair")
