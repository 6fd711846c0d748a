"""Stream milliseconds per clip of the exact-length air absorption (the
program's ``ars.air`` span), over the window's calls; shares the card with
the other batch in flight (``portbench.program_spans``)."""

from portbench import program_spans


def read(run):
    return program_spans.stream_ms_per_clip(run, "ars.air")
