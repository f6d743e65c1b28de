"""The most GB of (D, H, W) volumes the matcher held at once, over the
traced pairs: the largest ``volume_bytes`` count of the program's view
spans, ``stereo.sgm`` and ``stereo.right`` (program_counter), over 1e9."""

from perfbench import program_spans


def read(run):
    per = program_spans.request_spans(run)
    if per is None:
        return None
    held = [s.counts["volume_bytes"] for got in per for s in got
            if s.name in ("stereo.sgm", "stereo.right")
            and "volume_bytes" in s.counts]
    return max(held) / 1e9 if held else None
